"""Core: the device object tier (the runtime core is a later slice)."""
