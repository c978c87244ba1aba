"""The GPU scheduler extender: the twin of the JAX package's ``extender/``,
ported whole. It holds the filter/score plane (``server``,
``index``, ``reservations``) and gang admission (``gang``) with its
write-ahead journal (``journal``), its singleton lease (``leader``), sharded
admission (``sharding``, ``holdscodec``), the eviction planes
(``preemption``, ``defrag`` and ``rescue``) and the scheduling-quality
simulator that replays traces through them (``simulator``, its traces in
``sim_traces/``), and the control-plane scale bench that measures the
filter/score plane, admission and the evidence planes at cluster scale
(``scale_bench``). It imports neither ``torch`` nor ``jax``: a scheduler
pod holds no card."""
