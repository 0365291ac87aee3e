"""Command-line tools of the port, each run as
``python -m audio_processor_tpu_torch.tools.<name>``: ``make_bundled_diarizer``
(train, calibrate and validate the bundled diarizer), ``verify_parity`` (the
trained-checkpoint gates) and ``make_parity_case`` (a Whisper parity case)."""
