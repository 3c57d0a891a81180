"""Apple Mail reader."""
