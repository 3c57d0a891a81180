"""Training (``train.py``). The JAX package's mesh, sharded build and
sharded search are not ported yet."""
