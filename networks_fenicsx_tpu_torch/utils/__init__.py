"""Configuration and timing utilities."""
