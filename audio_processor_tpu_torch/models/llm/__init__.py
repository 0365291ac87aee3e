"""The meeting job's language-model stages: DeepSeek-V2 (MLA, YaRN, MoE) and
Kimi-Linear (KDA linear attention beside NoPE MLA, sigmoid-routed MoE)."""
