"""Multi-process runs on torch.distributed (counterpart of
deepsignal_plant_tpu/parallel/): the launch environment, input sharding
and per-rank outputs (``dist``), and the collectives the pipelines use
(``multihost``)."""
