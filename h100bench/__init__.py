"""The H100 benchmark of rvpt_tpu_torch.  Run one cell once with

    python3 -m h100bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root; ``BENCHMARK.json`` there lists the cells and
metrics.  Nothing here imports JAX or the JAX package."""
