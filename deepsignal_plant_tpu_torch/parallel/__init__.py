"""Multi-card runs (counterpart of deepsignal_plant_tpu/parallel/): on
torch.distributed, the launch environment, input sharding and per-rank
outputs (``dist``) and the collectives the pipelines use
(``multihost``); in one process, the per-card shares of a batch
(``mesh``)."""
