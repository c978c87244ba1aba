"""The GPU scheduler extender: the twin of the JAX package's ``extender/``,
ported slice by slice. This slice holds the filter/score plane (``server``,
``index``, ``reservations`` and the gang labels of ``gang``); gang
admission, its journal and leader, sharding, preemption, defragmentation,
rescue and the simulator come with later slices. It imports neither
``torch`` nor ``jax``: a scheduler pod holds no card."""
