"""The benchmark of `migan_tpu_torch` on NVIDIA GPUs.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations and end-to-end metrics are listed in the
`BENCHMARK.json` at the repository root; each configuration is a file in
`configs/`, each traffic mix a file in `traffic/` whose `kind` names the
code `traffic/<kind>.py`, each cell's correctness limits a file in
`workloads/`, and each per-layer metric a reader in `metrics/`. The plain
reference and the work counts (FLOPs, bytes, peaks) are in `reference/`.
Nothing here imports JAX or the JAX package; `reference/` imports nothing
of the program either.
"""
