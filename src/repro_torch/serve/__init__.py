"""LM serving: the batched prefill + greedy decode engine."""
