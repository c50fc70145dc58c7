"""Training: AdamW with cosine schedule and clipping, the ODB trainer."""
