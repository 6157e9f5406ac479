"""Serving entry points (the ported subset of ``repro.serving``)."""
