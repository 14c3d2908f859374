"""The entries a window drives, one module each, found by the `entry`
that a traffic file names. Each module's `Entry(codec, inputs, device)`
makes what its calls need in set-up and gives `warm_up()`, `call(k)` (one
call on input k: (bytes in, result)), `control(k)` (the result of the
cell's control on input k: the plain reference in the program's place
with a guarantee broken) and `check(sample)`: for (k, result) pairs, the
numbers compared, each (value, limit, "<=" or ">=")."""
