"""Data parallelism over torch.distributed (the port of
simple_tad_tpu/parallel): ``multihost`` finds the torchrun ranks and
gathers metrics and CSV shards; ``mesh`` holds the data-parallel group
the trainers and the optimizer use."""
