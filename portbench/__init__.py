"""The benchmark of the PyTorch / CUDA port (`repro_torch`).

Run a cell as ``python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Everything a
cell needs is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); every ``metrics/<metric>.py`` is a
per-layer reader of the traced run.
"""
