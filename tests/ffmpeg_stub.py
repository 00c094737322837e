"""A stand-in for the `ffmpeg` and `ffprobe` binaries, for machines that
have neither: it speaks the part of their command lines that the frame
sources of both packages use (`ffprobe ... -show_entries
stream=width,height[,nb_frames] -of json <input>` and `ffmpeg -v error
[-f v4l2] -i <input> -f rawvideo -pix_fmt rgb24 -`).

A "video file" is a `.npy` stack of uint8 [T, H, W, 3] frames under any
name (`clip.mp4`); a URL or a `/dev/video<N>` device serves the stack
named by `FFMPEG_STUB_STREAM`, `FFMPEG_STUB_FPS` frames a second (as fast
as the pipe takes them when unset). With `FFMPEG_STUB_LOG` set, every call
appends one JSON line (tool, arguments, pid) to that file.

`install(directory)` writes the two executables there, each this file run
by the Python that called `install`; put the directory first on `PATH`.
"""

import json
import os
import sys
import time

STREAM_ENV, FPS_ENV, LOG_ENV = ("FFMPEG_STUB_STREAM", "FFMPEG_STUB_FPS",
                                "FFMPEG_STUB_LOG")


def install(directory) -> list:
    """Write `ffmpeg` and `ffprobe` into `directory`; their paths."""
    src = open(os.path.abspath(__file__)).read()
    paths = []
    for tool in ("ffmpeg", "ffprobe"):
        path = os.path.join(str(directory), tool)
        with open(path, "w") as f:
            f.write(f"#!{sys.executable}\n{src}")
        os.chmod(path, 0o755)
        paths.append(path)
    return paths


def _frames(source: str):
    import numpy as np
    if source.startswith("/dev/video") or "://" in source:
        source = os.environ[STREAM_ENV]
    return np.load(source, mmap_mode="r"), source


def main(argv) -> int:
    tool = os.path.basename(argv[0])
    if os.environ.get(LOG_ENV):
        with open(os.environ[LOG_ENV], "a") as f:
            f.write(json.dumps({"tool": tool, "argv": argv[1:],
                                "pid": os.getpid()}) + "\n")
    if tool == "ffprobe":
        frames, _ = _frames(argv[-1])
        t, h, w = frames.shape[:3]
        entries = argv[argv.index("-show_entries") + 1]
        st = {"width": w, "height": h}
        if "nb_frames" in entries:
            st["nb_frames"] = str(t)
        print(json.dumps({"streams": [st]}))
        return 0
    frames, _ = _frames(argv[argv.index("-i") + 1])
    fps = float(os.environ.get(FPS_ENV) or 0)
    out = sys.stdout.buffer
    try:
        for frame in frames:
            out.write(frame.tobytes())
            out.flush()
            if fps:
                time.sleep(1.0 / fps)
    except BrokenPipeError:          # the reader closed the pipe: stop
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
