"""Model construction and weight import."""
