"""The smoke workload in PyTorch: model, weight bridge, training step and
the pod's self-check."""
