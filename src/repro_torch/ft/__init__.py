"""Fault tolerance for training: checkpointing and the health monitor."""
