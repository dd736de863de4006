"""The H100 benchmark of ``semseg_torch``: ``python3 bench_h100/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>`` (see README.md)."""
