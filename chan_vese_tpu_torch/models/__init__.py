"""Segmentation drivers: scalar (plain), fused (K1), banded (K2/K3)."""
