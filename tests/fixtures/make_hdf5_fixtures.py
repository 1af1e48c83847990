"""Write the HDF5 fixtures that the port's ``hdf5`` reader is held to on
every machine, the card's too (which has no ``h5py``): two files in the
corpus's own formats, written here by h5py, and what h5py reads in them.

- ``hdf5_jax_video_lzf.h5``: a lip video as the JAX builders write it
  (``avvad_tpu.builders._write_h5``: float32 (67, 67, T), one LZF chunk a
  frame), 66 frames, so that its chunk B-tree has two levels; the frames
  are the JAX pipeline's decode of the ``.mat`` below, rounded to whole
  grey levels (as 8-bit source video), so that LZF shrinks the chunks.
- ``hdf5_matlab_v73.mat``: a MATLAB v7.3-style DCT file: a 512-byte user
  block that starts with MATLAB's header text, one float64 (frames, 4489)
  dataset in chunks of 4 frames through shuffle and deflate, with a
  ``MATLAB_class`` attribute.
- ``hdf5_fixtures.json``: for each file and dataset, the shape, dtype and
  SHA-256 of the array as h5py reads it, and the number of chunks stored
  through LZF (filter mask 0).

Run from the repository root (needs h5py and the JAX package):
  python tests/fixtures/make_hdf5_fixtures.py
"""

import hashlib
import json
import os
import sys

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

MAT, VIDEO, META = "hdf5_matlab_v73.mat", "hdf5_jax_video_lzf.h5", "hdf5_fixtures.json"
N_MAT, N_VIDEO = 32, 66


def dct_frames(n: int, seed: int = 0) -> np.ndarray:
    """(n, 4489) DCT coefficients of smooth low-frequency fields, rounded
    to whole values."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(67), np.arange(67), indexing="ij")
    envelope = np.exp(-(i + j) / 6.0).ravel()
    base = rng.normal(size=4489)
    out = np.empty((n, 4489))
    for f in range(n):
        base = 0.9 * base + 0.45 * rng.normal(size=4489)
        out[f] = base * envelope * 120.0
    out[:, 0] += 4000.0
    return np.round(out)


def write_mat(path: str, data: np.ndarray) -> None:
    with h5py.File(path, "w", userblock_size=512) as f:
        d = f.create_dataset("dctFrames", data=data, chunks=(4, 4489), shuffle=True,
                             compression="gzip", compression_opts=4)
        d.attrs["MATLAB_class"] = np.bytes_("double")
    with open(path, "r+b") as fh:
        fh.write(b"MATLAB 7.3 MAT-file, Platform: GLNXA64".ljust(128, b" "))


def describe(path: str) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        for name, d in f.items():
            a = np.ascontiguousarray(d[()])
            lzf = 0
            if d.compression == "lzf":
                lzf = sum(d.id.get_chunk_info(i).filter_mask == 0
                          for i in range(d.id.get_num_chunks()))
            out[name] = {"shape": list(a.shape), "dtype": a.dtype.str,
                         "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                         "lzf_chunks": int(lzf)}
    return out


def main() -> None:
    from avvad_tpu.builders import _write_h5
    from avvad_tpu.processing.video import decode_and_upsample

    mat = os.path.join(HERE, MAT)
    write_mat(mat, dct_frames(N_MAT))
    video = decode_and_upsample(mat)[..., :N_VIDEO]
    if video.shape != (67, 67, N_VIDEO):
        raise SystemExit(f"decoded video {video.shape}")
    _write_h5(os.path.join(HERE, VIDEO), "X", np.round(video))
    meta = {name: describe(os.path.join(HERE, name)) for name in (MAT, VIDEO)}
    with open(os.path.join(HERE, META), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    for name in (MAT, VIDEO):
        print(name, os.path.getsize(os.path.join(HERE, name)), meta[name])


if __name__ == "__main__":
    main()
