"""One process a card over ``torch.distributed``: the bootstrap, the data mesh, FSDP."""
