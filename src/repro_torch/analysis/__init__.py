"""Checks on compiled specs and schedule ids (the part of the reference's
``repro.analysis`` that the fault loop needs)."""
