"""The generators of the benchmark's inputs, one module each, found by
the `generator` that a traffic file names. Each module's
`inputs(traffic, seed)` returns the list of inputs a run's calls take in
turn (bytes), made from the traffic file's parameters and `--seed`: the
same seed gives the same inputs."""
