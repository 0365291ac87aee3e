"""Host C++ ingest: the WAV decoder and resampler (``audio_io``) and the
codec-library decoder for m4a/aac/mp3/ogg/flac (``media``), built with g++
at first use (``build``)."""
