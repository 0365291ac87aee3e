"""Whisper model-family configuration.

A copy of the JAX package's ``models/whisper/config.py`` (WhisperConfig
and the presets): dimensions follow the published Whisper architecture
table so converted checkpoints drop straight in.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WhisperConfig:
    name: str = "tiny"
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    # cross-attention heads that track the audio timeline, as (layer, head)
    # pairs (word-timestamp alignment, models/whisper/align.py); carried through
    # checkpoint I/O so a converted .npz round-trips unchanged
    alignment_heads: tuple[tuple[int, int], ...] | None = None

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        """Delegates to the one derivation (decode.SpecialTokens)."""
        from .decode import SpecialTokens

        return SpecialTokens.for_config(self).num_languages


_PRESETS = {
    # name: (n_mels, state, heads, enc_layers, dec_layers, vocab)
    "tiny.en": (80, 384, 6, 4, 4, 51864),
    "tiny": (80, 384, 6, 4, 4, 51865),
    "base.en": (80, 512, 8, 6, 6, 51864),
    "base": (80, 512, 8, 6, 6, 51865),
    "small.en": (80, 768, 12, 12, 12, 51864),
    "small": (80, 768, 12, 12, 12, 51865),
    "medium.en": (80, 1024, 16, 24, 24, 51864),
    "medium": (80, 1024, 16, 24, 24, 51865),
    "large-v1": (80, 1280, 20, 32, 32, 51865),
    "large-v2": (80, 1280, 20, 32, 32, 51865),
    "large-v3": (128, 1280, 20, 32, 32, 51866),
    "large-v3-turbo": (128, 1280, 20, 32, 4, 51866),
    # tiny configs for tests/benches without checkpoints
    "test": (80, 64, 2, 2, 2, 1024),
}


def get_config(name: str) -> WhisperConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown Whisper preset {name!r}; options: {sorted(_PRESETS)}")
    n_mels, state, heads, enc_l, dec_l, vocab = _PRESETS[name]
    return WhisperConfig(
        name=name,
        n_mels=n_mels,
        n_audio_state=state,
        n_audio_head=heads,
        n_audio_layer=enc_l,
        n_text_state=state,
        n_text_head=heads,
        n_text_layer=dec_l,
        n_vocab=vocab,
    )
