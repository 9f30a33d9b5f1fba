"""Host-side data: cropping, preprocessing, dataset files, patch and video loaders."""
