"""Serving: the batched greedy engine."""
