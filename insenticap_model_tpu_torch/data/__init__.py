"""The data path: batch assembly, loaders and feature stores."""
