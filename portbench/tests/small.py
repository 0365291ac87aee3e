"""Small cells for the CPU tests: whisper tiny's widths (d 384, 6 heads,
4 + 4 layers, the full multilingual vocabulary), a short token cap, and
the cells' own mixes and metrics, cut to short recordings, with the
logit-gap limit set for these widths."""
from __future__ import annotations

from portbench import harness

TINY = dict(name="tiny", d_model=384, encoder_layers=4, decoder_layers=4,
            encoder_attention_heads=6, decoder_attention_heads=6,
            encoder_ffn_dim=1536, decoder_ffn_dim=1536, num_mel_bins=80, vocab_size=51865)


def small_cell(root, meeting_s: float = 75.0, max_new_tokens: int = 24) -> dict:
    f = harness.cell_files(root, "turbo.meeting_30min")
    f["cfg"] = dict(f["cfg"], **TINY, max_new_tokens=max_new_tokens)
    f["mix"] = dict(f["mix"], meeting_s=meeting_s, pool=1)
    # The limit at these widths, from readings on the CPU over 8 seeds of
    # the 75 s meeting (72 served tokens): the program's widest gap 0 to
    # 0.0063, the control's 0.011 to 0.080 (0.047 on the tests' seed).
    f["limits"] = dict(f["limits"], max_logit_gap=0.02)
    return f

