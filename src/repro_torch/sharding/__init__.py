"""The JAX package's ``repro/sharding`` as far as the port runs it: the
performance switches of :mod:`repro_torch.sharding.opts`.  The mesh, its
partition rules and the dry-run's specs are not ported yet."""
