"""Multi-device sharding: corpus-sharded build and search over a device list."""
