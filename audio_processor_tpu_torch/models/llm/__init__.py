"""DeepSeek-V2 (MLA, YaRN, MoE) for the meeting job's language-model stages."""
