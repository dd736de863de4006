"""Inference engine (sliding-window evaluator)."""
