"""Distributed training helpers (port of `repro.distributed`): so far the
error-feedback int8 gradient compression."""
