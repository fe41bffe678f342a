"""Audio -> landmark models of the port (AniPortrait's wav2vec2 front)."""
