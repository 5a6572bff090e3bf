"""Optimizer and gradient communication."""
