"""Serving steps of the LM: prefill, decode and greedy generation."""
