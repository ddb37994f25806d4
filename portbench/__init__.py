"""The benchmark of the PyTorch and CUDA port (``harp_tpu_torch``) on
NVIDIA H100 cards: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``run.py``).  It imports neither JAX nor
the JAX package."""
