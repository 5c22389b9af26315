"""The benchmark of ``accvlab_tpu_torch``: one run of one cell of
``BENCHMARK.json`` (``python3 -m portbench.run``), its reference and its
readers. It imports neither JAX nor the JAX package."""
