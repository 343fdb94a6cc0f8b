"""Masked-image-modeling pretraining: SparK, AnatoMask, EMA, the step."""
