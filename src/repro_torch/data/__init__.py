"""Deterministic synthetic data (the port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticLM
