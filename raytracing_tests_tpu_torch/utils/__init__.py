"""Framework utilities: device selection, image IO."""
