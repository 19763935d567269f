"""Fused similarity → top-k (→ label vote) (ECCOS-R / ECCOS-H hot loop)."""
