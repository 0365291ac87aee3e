"""The port's counterparts of the JAX package's kernel probes in
``benchmarks/``: each runs its variants through the port's Hopper kernels on
the card (``--device cpu`` runs their plain versions).

    python -m audio_processor_tpu_torch.benchmarks.kernel_v32_probe
    python -m audio_processor_tpu_torch.benchmarks.kernel_v34_probe
    python -m audio_processor_tpu_torch.benchmarks.kernel_v4_probe
"""
