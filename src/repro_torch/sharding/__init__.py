"""The JAX package's ``repro/sharding``: the performance switches
(:mod:`.opts`), the partition rules (:mod:`.rules`) and the in-model
constraint (:mod:`.specs`), over ``torch.distributed`` DTensor."""
