"""audio_processor_tpu_torch — the PyTorch / CUDA port for one NVIDIA H100.

A second package beside ``audio_processor_tpu`` (the JAX reference, which
it never imports).  This slice carries the batched Whisper transcription
main path: int16 30 s chunks -> fused log-mel (CUDA kernel) -> encoder ->
int4 cross-KV greedy decode (CUDA kernel for the decode cross-attention)
-> timestamped segments.

Subpackages
-----------
runtime      Device resolution (CUDA unless the caller asks for the CPU).
ops          Log-mel frontend and the hand-written Hopper kernels
             (``ops/kernels``; CUDA C++ sources under ``csrc/``).
models       Whisper config, tokenizer, checkpoint I/O, encoder, decode.
pipeline     Ingest and the ``Transcriber``.
utils        WAV I/O and the trim-time map.
"""

__version__ = "0.1.0"
