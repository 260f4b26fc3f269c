"""Gaussian map store and per-frame optimizer state."""
