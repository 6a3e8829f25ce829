"""Elementwise math, resampling and Gaussian-mixture operations."""
