"""The benchmark of tpu_snappy_torch, the PyTorch and CUDA port.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`, from the root of a checkout on a machine with the card,
runs one cell of BENCHMARK.json and prints one JSON object as its last
line. Everything it measures against lives here: the traffic files
(traffic/) and the generators they name (generators/), the
configurations (configs/), the entries the window drives and their
controls (entries/), one reader a metric (metrics/), the spans and the
trace reduction (probe.py), the kernels' bounds (yardstick.py) and the
plain Snappy codec the outputs are held to (reference.py). A cell,
configuration, mix or metric is added as files and BENCHMARK.json
entries, with no edit to a file that is there. It imports nothing of JAX
or of the JAX package.
"""
