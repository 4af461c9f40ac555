"""Traffic kinds: one general generator and driver a kind."""
