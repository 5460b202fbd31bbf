"""Training: the engine, dataset assembly, evaluation and checkpoints."""
