"""Multi-device herds (sharding) and the multi-process herd (multihost)."""
