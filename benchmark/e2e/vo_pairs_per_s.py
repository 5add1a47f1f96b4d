"""Frame pairs posed by the ``frames_to_poses`` calls of the window, over the
window's seconds: the window runs from the first call to the end of the
last, so every pair counted was posed inside it."""


def read(window):
    return window["units"] / window["window_s"]
