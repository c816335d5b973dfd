"""Host-side layered-model building (YAML settings -> layer profiles)."""
