"""Host-side viewing: PNG frames, animated sequences, and a standalone HTML
player.

The reference's interactivity lives in a browser (orbit controls, lil-gui,
index.html:716-871). nbx renders on device and ships u8 frames;
this module writes them as PNGs and can emit a self-contained HTML file that
plays a recorded trajectory with a canvas 3D projection — the decoupled
equivalent of the reference's live three.js view.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np


class AsyncReadback:
    """Double-buffered host readback: submit frame k+1's device computation
    before materializing frame k, so the host transfer overlaps the next
    step+render (the async-readback half of SURVEY.md section 7's rendering
    plan — JAX dispatch is already asynchronous; this object just delays the
    materialization point by one frame).

    Usage:
        rb = AsyncReadback()
        for ...:
            state, ev = sim.step(state, cfg)
            fr, img = render_and_advance(fr, state, cfg, ev, cam)
            ready = rb.push(img)      # returns the PREVIOUS frame (or None)
            if ready is not None: write_png(..., ready)
        last = rb.flush()
    """

    def __init__(self):
        self._pending = None

    def push(self, device_img) -> np.ndarray | None:
        prev = self._pending
        self._pending = device_img
        return np.asarray(prev) if prev is not None else None

    def flush(self) -> np.ndarray | None:
        prev, self._pending = self._pending, None
        return np.asarray(prev) if prev is not None else None


def to_u8(img) -> np.ndarray:
    """[H, W, 3] float in [0,1] -> u8."""
    a = np.asarray(img)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def png_bytes(img, level: int = 6) -> bytes:
    """Encode [H, W, 3] (float in [0,1] or u8) as PNG bytes. Pure stdlib
    (zlib) — no imaging dependency needed on a headless host."""
    a = to_u8(img) if np.asarray(img).dtype != np.uint8 else np.asarray(img)
    h, w, _ = a.shape
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img, level: int = 6) -> None:
    """Write [H, W, 3] (float in [0,1] or u8) as a PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(img, level))


def write_frames(dirpath: str, frames, prefix: str = "frame") -> list[str]:
    """Write a [T, H, W, 3] stack as numbered PNGs."""
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    arr = np.asarray(frames)
    for t in range(arr.shape[0]):
        p = os.path.join(dirpath, f"{prefix}_{t:05d}.png")
        write_png(p, arr[t])
        paths.append(p)
    return paths


def record_trajectory(
    path: str,
    positions,  # [T, N, 3]
    radii,  # [N] or [T, N]
    temps=None,  # [T, N] optional
    mats=None,  # [N] optional
    stride: int = 1,
    max_bodies: int = 2000,
) -> None:
    """Dump a decimated trajectory as JSON for the HTML player."""
    pos = np.asarray(positions)[::stride]
    t_len, n = pos.shape[0], pos.shape[1]
    keep = min(n, max_bodies)
    rad = np.asarray(radii)
    if rad.ndim == 1:
        rad = np.broadcast_to(rad, (t_len, n))
    else:
        rad = rad[::stride]
    data = {
        "pos": np.round(pos[:, :keep], 3).tolist(),
        "radius": np.round(rad[:, :keep], 3).tolist(),
        "temp": (
            np.round(np.asarray(temps)[::stride][:, :keep], 2).tolist()
            if temps is not None
            else None
        ),
        "mat": np.asarray(mats)[:keep].tolist() if mats is not None else None,
    }
    with open(path, "w") as f:
        json.dump(data, f)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nbx player</title>
<style>body{margin:0;background:#000;overflow:hidden;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;color:#888}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
const DATA = __DATA__;
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
const hud = document.getElementById('hud');
let yaw = 0.6, pitch = 0.4, dist = 250, t = 0, playing = true;
function resize(){canvas.width=innerWidth;canvas.height=innerHeight;}
addEventListener('resize', resize); resize();
let drag=null;
canvas.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(drag){yaw+=(e.clientX-drag[0])*0.005;
pitch+=(e.clientY-drag[1])*0.005;drag=[e.clientX,e.clientY];}});
addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);});
addEventListener('keydown',e=>{if(e.key===' ')playing=!playing;});
function colorOf(temp, mat){
  const base = [[0.35,0.25,0.18],[0.5,0.5,0.6],[0.5,0.7,0.9]][mat||0];
  const h = Math.min((temp||0)/50, 1);
  const r = base[0]*(1-0.7*h)+1.0*0.7*h, g = base[1]*(1-0.7*h)+0.3*0.7*h,
        b = base[2]*(1-0.7*h)+0.1*0.7*h;
  return `rgb(${r*255|0},${g*255|0},${b*255|0})`;
}
function frame(){
  const pos = DATA.pos[t|0], rad = DATA.radius[t|0];
  const temp = DATA.temp ? DATA.temp[t|0] : null;
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const f = canvas.height/2/Math.tan(22.5*Math.PI/180);
  ctx.fillStyle='rgba(0,0,0,0.35)';ctx.fillRect(0,0,canvas.width,canvas.height);
  const pts=[];
  for(let i=0;i<pos.length;i++){
    const [x,y,z]=pos[i];
    let X=cy*x+sy*z, Z=-sy*x+cy*z, Y=cp*y-sp*Z; Z=sp*y+cp*Z+dist;
    if(Z<1) continue;
    pts.push([canvas.width/2+f*X/Z, canvas.height/2-f*Y/Z,
              Math.max(f*rad[i]/Z,0.7), Z, i]);
  }
  pts.sort((a,b)=>b[3]-a[3]);
  for(const [px,py,pr,_,i] of pts){
    ctx.fillStyle=colorOf(temp?temp[i]:0, DATA.mat?DATA.mat[i]:0);
    ctx.beginPath();ctx.arc(px,py,pr,0,7);ctx.fill();
  }
  hud.textContent=`frame ${t|0}/${DATA.pos.length-1}  bodies ${pos.length}  [space]=pause  drag=orbit  wheel=zoom`;
  if(playing) t=(t+0.5)%DATA.pos.length;
  requestAnimationFrame(frame);
}
frame();
</script></body></html>
"""


def write_html_player(path: str, trajectory_json_path: str) -> None:
    """Emit a self-contained HTML player embedding the recorded trajectory
    (orbit + zoom + pause — the reference's view-mode interactions)."""
    with open(trajectory_json_path) as f:
        data = f.read()
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.replace("__DATA__", data))
