"""Synthetic articulated-hand scenes (data.synth)."""
