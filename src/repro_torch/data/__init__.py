"""Data (port of `repro.data`): the synthetic token pipeline."""
