"""The benchmark of the PyTorch and CUDA port, `repro_torch`.

`python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1`
runs one cell of `BENCHMARK.json` once on the card and prints one JSON
line. Everything a cell needs is found by name: its configuration in
`configs/`, its traffic mix in `traffic/` (a data file whose `driver`
names a module of `drivers/`), its correctness limits in `checks/`, and
each per-layer metric's reader in `metrics/`.
"""
