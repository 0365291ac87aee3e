"""audio_processor_tpu_torch — the PyTorch / CUDA port for one NVIDIA H100.

A second package beside ``audio_processor_tpu`` (the JAX reference, which
it never imports): the meeting-notes service, whose device stages are
Whisper transcription (int16 30 s chunks -> fused log-mel (CUDA kernel) ->
encoder -> int4 cross-KV decode (CUDA kernel for the decode
cross-attention) -> timestamped segments) and diarization.

Subpackages
-----------
runtime       Device resolution (CUDA unless the caller asks for the CPU),
              the device probe, the job store and engine, ``build_services``.
ops           Log-mel frontend and the hand-written Hopper kernels
              (``ops/kernels``; CUDA C++ sources under ``csrc/``).
models        Whisper and the diarization nets.
parallel      The (data, model) mesh on ``torch.distributed``.
native        Host C++ ingest built with g++ at first use: the WAV decoder
              and resampler, and the codec-library (m4a/aac/...) decoder.
pipeline      Ingest, the ``Transcriber``, the ``Diarizer``, fusion and the
              9-stage meeting job.
integrations  Drive, PDF, Gemini, Notion and the credential store.
server        The WSGI app: the job API and the OpenAI-compatible ``/v1``.
utils         WAV I/O, timestamps, metrics, writers, constants.
tools         The bundled diarizer's builder and the trained-checkpoint
              parity gates (``python -m audio_processor_tpu_torch.tools.<name>``).
"""

__version__ = "0.1.0"
