"""Checkpoint / restore (the RDB v19 codec role, src/serializers/)."""
