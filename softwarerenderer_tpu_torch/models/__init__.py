"""Packed scene -> device tensors."""
