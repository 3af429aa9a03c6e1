"""Host-side data handling of the port: the demo's image and mask IO."""
