"""Headless rendering: rasterizer, AVI writer, video recorder."""
from .avi import AviWriter
from .raster import render_frame, view_window
from .video import VideoRecorder
