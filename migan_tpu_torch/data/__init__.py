"""Host-side data handling of the port: the demo's image and mask IO, the
free-form mask generators (PIL, and the native C++ rasterizer), the
training datasets (Places2, FFHQ) and the batch loaders."""
