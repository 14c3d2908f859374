"""Encode and decode pipelines on PyTorch tensors."""
