"""Models: torchvision-topology ResNets, seeded init, Flax weight carry-over."""
