"""The sharded layer: a (data, tile) mesh of ranks over
``torch.distributed``, one process and one device a rank."""
