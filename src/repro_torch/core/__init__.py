"""Algorithm core: config types, registry, protocols, DC-S3GD and its pieces."""
