"""Framework-free helpers (logging, palette PNGs, directories)."""
