"""Decode-side inference: sampling and the paged decode model's pools."""
