"""Host-side data handling of the port: the demo's image and mask IO, the
free-form mask generator and the evaluation's batch loader."""
