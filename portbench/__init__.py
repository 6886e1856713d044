"""The benchmark of deepsignal_plant_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line; ``held_back.json`` lists, in the same shape, the cells
whose files are kept but that BENCHMARK.json leaves out. Everything a
cell needs is found by name:

- ``configs/<config>.json``: the model's published sizes and dtype;
- ``workloads/<cell>.json``: the entry that drives the program, its
  options, and the limits of the comparison that decides ``correct``;
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  generator module ``traffic/<kind>.py`` that the mix names, which may
  export the faults of its input (``FAULTS``);
- ``entries/<entry>.py``: how one pass over the cell's input is run, and
  any checks of its own;
- ``metrics/<metric>.py``: one reader per metric, over the run's record;
- ``kernels/*.json``: kernel-name patterns, by group, for the trace.

The yardstick (generators, the v3 container writer, the fast5 writer and
VBZ encoder, the FLOP, byte and peak arithmetic, the trace reduction,
the plain references of the model and of extraction, and the
comparison) lives here and imports nothing of the program, except the
entries, which drive it.
"""
