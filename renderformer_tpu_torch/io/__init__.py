"""File formats of the port: safetensors weights, HDF5 files and the H5
scenes in them, EXR and PNG images and MP4 video.

``safetensors``, ``hdf5`` (the HDF5 codec, numpy, ``zlib`` and ``struct``),
``h5`` and ``image`` need numpy and torch only; ``image.write_video``
imports ``cv2`` where it is called, so every module imports on a machine
that has none.
"""
