"""Runtime services shared by serving and training (the ported subset of
``repro.runtime``)."""
