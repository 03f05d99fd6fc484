"""Process worlds and device meshes for the port's data-parallel paths."""
