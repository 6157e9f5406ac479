"""Model layers, attention and the dense transformer (the ported subset of
``repro.models``)."""
