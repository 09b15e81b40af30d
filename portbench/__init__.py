"""The port's benchmark: one cell of ``BENCHMARK.json`` a run
(``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``). It measures ``reni_tpu_torch`` on the card and imports
nothing of the JAX package."""
