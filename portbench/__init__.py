"""The benchmark of ``qbot_tpu_torch`` on one NVIDIA H100: ``python3 -m
portbench --workload NAME --seed N --seconds S --trace 0|1`` (see
``portbench/run.py`` and ``portbench/README.md``)."""
