"""File formats of the port: safetensors weights, H5 scenes, EXR and PNG
images and MP4 video.

``safetensors`` and ``image`` need numpy and torch only; ``h5`` imports
``h5py`` and ``image.write_video`` imports ``cv2`` where they are called, so
every module imports on a machine that has neither.
"""
