"""Captioner and image-sentiment detector (serving parts)."""
