"""The coefficient-matrix visualizer (``viz.visualize``)."""
