"""Host-side utilities: device choice, datasets, images, logging."""
