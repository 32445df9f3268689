"""The benchmark of ``multilingual_kws_tpu_torch`` on one H100.

``python -m kwsbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once (``run.py``). Everything a cell is made of is found by
name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its driver (``drivers/<driver>.py``), its
traffic parameters and its metrics (``metrics/<metric>.py``).
"""
