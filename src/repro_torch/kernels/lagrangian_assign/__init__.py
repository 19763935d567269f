"""Fused Lagrangian dual ascent (ECCOS optimizer, Eq. 9-12)."""
