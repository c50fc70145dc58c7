"""Three-term roofline of the dry run's cells at an H100's peaks, and the
per-device cost of a local program counted on the meta device."""
