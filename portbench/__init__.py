"""The benchmark of ``dvae_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one model configuration, one cell
or one per-layer metric is a file of its own, found by name:

  * ``configs/<config>.json``   the configuration as it is run;
  * ``workloads/<cell>.json``   the cell: its configuration, traffic kind
    and the traffic's parameters, and the limits of its correctness check;
  * ``traffic/<kind>.py``       the generator and loop of one traffic kind;
  * ``metrics/<metric>.py``     the reader of one per-layer metric.

``reference/`` holds the plain PyTorch model the check compares against,
``core/`` the rest of the yardstick (work counts, peaks, trace reduction,
synthetic data and weights, the comparisons).
"""
