"""Browser UI for the trajectory workload, on the card: the stdlib's HTTP server.

Counterpart of mofa_tpu/apps/ui_server.py (the reference's gradio Blocks
apps, MOFA-Video-Traj/run_gradio.py:634-838, served without gradio): upload
an image, click trajectory points, paint a motion brush, preview the CMP
flow, run. One page, no dependencies beyond the port's own.

    python -m mofa_tpu_torch.apps.ui_server --bf16             # on the card
    python -m mofa_tpu_torch.apps.ui_server --device cpu --tiny --num_frames 3 \
        --num_inference_steps 1

Endpoints (JSON unless noted):
  GET  /            the page
  POST /preprocess  {image: dataURL, target_size} -> {image: dataURL,
                    height, width}: shortest side to target_size, centre
                    crop to multiples of 64 (run_gradio.py:663-689)
  POST /preview     {image, tracks} -> {flow: dataURL, hint: dataURL}: the
                    CMP flow of the last frame and the drawn tracks
                    (run_gradio.py:372-485)
  POST /run         {image, tracks, brush?} -> {video: "/video"}:
                    `traj_app.generate` with the server's settings
  POST /run_landmarks  {image, landmarks (base64 .npy), mode: hybrid |
                    keypoint, tracks? and brush? (hybrid only: its drag
                    tracks and face mask), target_size?} -> {video:
                    "/video"}: `hybrid_app.run` / `keypoint_app.run` with
                    the server's --device
  GET  /video       the last rendered mp4

Images travel as data URLs and go through cv2 (`preprocess/image.py`:
decoded as `read_image` decodes a file, alpha dropped without compositing
as Pillow's convert("RGB") drops it); the server needs no PIL. State lives
in the browser; the server keeps the CMP and the diffusion bundle, loaded
at first use (seeded random weights where no file is given), and runs one
generation at a time. A request that fails gets a 500 with the error's
message (its traceback goes to the log) and the server keeps serving. It
runs on the CUDA device unless `--device cpu` is given, and raises when
there is none.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp, write_video
from mofa_tpu_torch.apps.traj_app import drag_flow, generate, resolve_device
from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
from mofa_tpu_torch.models.cmp.model import TINY_CMP_CONFIG, CMPConfig
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.ops.flow_viz import flow_to_image
from mofa_tpu_torch.preprocess.image import decode_image
from mofa_tpu_torch.preprocess.traj import (DragFlowEngine, preprocess_image,
                                            visualize_drag)
from mofa_tpu_torch.utils.logging import get_logger
from mofa_tpu_torch.utils.profiling import PhaseTimer

logger = get_logger("ui_server")

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>MOFA-Video</title><style>
body{font-family:sans-serif;margin:20px;background:#15181d;color:#e6e6e6}
canvas{border:1px solid #555;cursor:crosshair}
button{margin:4px;padding:6px 12px;background:#2b6cb0;color:#fff;border:0;
border-radius:4px;cursor:pointer} button.alt{background:#4a5568}
#row{display:flex;gap:16px} .col{display:flex;flex-direction:column}
img{border:1px solid #555}</style></head><body>
<h2>MOFA-Video — trajectory animation</h2>
<input type="file" id="file" accept="image/*">
<div id="row"><div class="col">
<canvas id="cv" width="512" height="512"></canvas>
<div>
<button id="newtrack">New trajectory</button>
<button id="brush" class="alt">Brush: off</button>
<button id="clear" class="alt">Clear</button>
<button id="preview">Preview flow</button>
<button id="run">Run</button>
</div>
<div>
<select id="lmmode"><option value="hybrid">hybrid (dual adapter)</option>
<option value="keypoint">keypoint (long video)</option></select>
<input type="file" id="lmfile" accept=".npy">
<button id="runlm">Run landmarks</button>
</div></div>
<div class="col"><img id="flow" width="256"><img id="hint" width="256">
<video id="out" width="256" controls></video></div></div>
<pre id="log"></pre><script>
let img=null, tracks=[[]], brushMode=false, drawing=false;
const cv=document.getElementById('cv'), ctx=cv.getContext('2d');
const bc=document.createElement('canvas'), bctx=bc.getContext('2d');
const log=m=>document.getElementById('log').textContent=m;
function redraw(){ if(!img)return; ctx.drawImage(img,0,0);
 ctx.globalAlpha=0.35; ctx.drawImage(bc,0,0); ctx.globalAlpha=1;
 for(const tr of tracks){ ctx.strokeStyle='#f33'; ctx.beginPath();
  tr.forEach((p,i)=>i?ctx.lineTo(p[0],p[1]):ctx.moveTo(p[0],p[1]));
  ctx.stroke(); for(const p of tr){ctx.fillStyle='#ff0';
  ctx.fillRect(p[0]-3,p[1]-3,6,6);} } }
document.getElementById('file').onchange=async e=>{
 const r=new FileReader(); r.onload=async()=>{
  const resp=await post('/preprocess',{image:r.result,target_size:512});
  img=new Image(); img.onload=()=>{cv.width=img.width;cv.height=img.height;
   bc.width=img.width;bc.height=img.height;tracks=[[]];redraw();};
  img.src=resp.image; };
 r.readAsDataURL(e.target.files[0]); };
cv.onmousedown=e=>{ if(brushMode){drawing=true;paint(e);} };
cv.onmousemove=e=>{ if(brushMode&&drawing)paint(e); };
cv.onmouseup=e=>{ if(brushMode){drawing=false;return;}
 const r=cv.getBoundingClientRect();
 tracks[tracks.length-1].push([e.clientX-r.left,e.clientY-r.top]);
 redraw(); };
function paint(e){ const r=cv.getBoundingClientRect();
 bctx.fillStyle='#fff'; bctx.beginPath();
 bctx.arc(e.clientX-r.left,e.clientY-r.top,14,0,7); bctx.fill(); redraw(); }
document.getElementById('newtrack').onclick=()=>tracks.push([]);
document.getElementById('brush').onclick=e=>{brushMode=!brushMode;
 e.target.textContent='Brush: '+(brushMode?'on':'off');};
document.getElementById('clear').onclick=()=>{tracks=[[]];
 bctx.clearRect(0,0,bc.width,bc.height); redraw();};
async function post(u,b){ const r=await fetch(u,{method:'POST',
 headers:{'Content-Type':'application/json'},body:JSON.stringify(b)});
 if(!r.ok) throw new Error(await r.text()); return r.json(); }
document.getElementById('preview').onclick=async()=>{ log('CMP preview…');
 try{ const r=await post('/preview',{image:img.src,
  tracks:tracks.filter(t=>t.length>1)});
  document.getElementById('flow').src=r.flow;
  document.getElementById('hint').src=r.hint; log(''); }
 catch(e){log(e.message)} };
document.getElementById('run').onclick=async()=>{ log('rendering…');
 try{ const r=await post('/run',{image:img.src,
  tracks:tracks.filter(t=>t.length>1),
  brush:bc.toDataURL()});
  document.getElementById('out').src=r.video+'?t='+Date.now(); log(''); }
 catch(e){log(e.message)} };
document.getElementById('runlm').onclick=async()=>{
 const f=document.getElementById('lmfile').files[0];
 if(!f){log('choose a landmarks .npy');return;}
 log('rendering (landmarks)…');
 const buf=await f.arrayBuffer();
 const b64=btoa(String.fromCharCode(...new Uint8Array(buf)));
 try{ const r=await post('/run_landmarks',{image:img.src,landmarks:b64,
  mode:document.getElementById('lmmode').value,
  tracks:tracks.filter(t=>t.length>1), brush:bc.toDataURL()});
  document.getElementById('out').src=r.video+'?t='+Date.now(); log(''); }
 catch(e){log(e.message)} };
</script></body></html>"""


def data_url_to_array(url: str) -> np.ndarray:
    """A data URL (PNG, JPEG, ...) -> uint8 [H, W, 3] RGB."""
    _, payload = url.split(",", 1)
    return decode_image(base64.b64decode(payload))


def array_to_data_url(arr: np.ndarray) -> str:
    """[H, W, 3] RGB or [H, W] -> a PNG data URL (values cast to uint8)."""
    import cv2
    arr = np.asarray(arr).astype(np.uint8)
    ok, png = cv2.imencode(".png", arr[..., ::-1] if arr.ndim == 3 else arr)
    if not ok:
        raise ValueError(f"cannot encode a {arr.shape} image as PNG")
    return "data:image/png;base64," + base64.b64encode(png.tobytes()).decode()


def _tracks(req) -> list:
    tracks = [[tuple(p) for p in tr] for tr in req.get("tracks") or []]
    if not tracks:
        raise ValueError("add at least one trajectory with 2+ points")
    return tracks


class TrajUIBackend:
    """The models and the request logic, apart from the HTTP plumbing (the
    tests drive it directly)."""

    def __init__(self, args):
        self.args = args
        self.device = resolve_device(args.device)
        self._lock = threading.Lock()
        self._cmp = None
        self._bundle = None
        self.last_video: bytes | None = None

    # --- models, loaded once ------------------------------------------------
    def cmp(self):
        if self._cmp is None:
            cfg = TINY_CMP_CONFIG if self.args.tiny else CMPConfig()
            self._cmp = load_cmp(self.args.cmp_ckpt, self.device, cfg=cfg)
        return self._cmp

    def bundle(self):
        if self._bundle is None:
            cfg_kw = (dict(unet_cfg=MICRO_UNET_CONFIG, vae_cfg=TINY_VAE_CONFIG,
                           clip_cfg=TINY_CLIP_CONFIG) if self.args.tiny else {})
            dtype = torch.bfloat16 if self.args.bf16 else torch.float32
            self._bundle = load_bundle(self.args.svd_dir, self.args.controlnet_dir,
                                       self.device, dtype, **cfg_kw)
        return self._bundle

    # --- endpoints ----------------------------------------------------------
    def preprocess(self, req):
        image01, (h, w) = preprocess_image(
            data_url_to_array(req["image"]),
            int(req.get("target_size", self.args.target_size)))
        return {"image": array_to_data_url(image01 * 255.0), "height": h, "width": w}

    def preview(self, req):
        """The CMP flow of the last frame and the tracks drawn on the image."""
        image = data_url_to_array(req["image"]).astype(np.float32) / 255.0
        tracks = _tracks(req)
        with self._lock, torch.no_grad():
            flow = drag_flow(DragFlowEngine(self.cmp()),
                             torch.from_numpy(image).to(self.device)[None], tracks,
                             self.args.num_frames)
        flow = flow[0, -1].float().cpu().numpy()
        return {"flow": array_to_data_url(flow_to_image(flow)),
                "hint": array_to_data_url(visualize_drag(image, tracks))}

    def run(self, req):
        """The trajectory video of the image, tracks and brush:
        `traj_app.generate` on the server's models and settings."""
        image = data_url_to_array(req["image"]).astype(np.float32) / 255.0
        h, w = image.shape[:2]
        if h % 64 or w % 64:
            raise ValueError(f"the image is {h}x{w}: both sides must be multiples "
                             "of 64 (POST it to /preprocess first)")
        tracks = _tracks(req)
        brush = None
        if req.get("brush"):
            brush = data_url_to_array(req["brush"]).max(axis=-1).astype(np.float32)
            if brush.shape != (h, w):
                raise ValueError(f"the brush is {brush.shape}, the image {(h, w)}")
            if brush.max() <= 0:
                brush = None
        a = self.args
        with self._lock:
            frames, _ = generate(
                image, tracks, self.cmp, self.bundle, timer=PhaseTimer(self.device),
                brush=brush, num_frames=a.num_frames,
                num_inference_steps=a.num_inference_steps, ctrl_scale=a.ctrl_scale,
                decode_chunk_size=a.decode_chunk_size, seed=a.seed)
            self.last_video = _mp4_bytes(frames, a.fps)
        return {"video": "/video"}

    def run_landmarks(self, req):
        """The landmark-driven workloads through their CLIs: the hybrid dual
        adapter or the keypoint long video."""
        import cv2
        mode = req.get("mode", "hybrid")
        if mode not in ("hybrid", "keypoint"):
            raise ValueError("mode must be 'hybrid' or 'keypoint'")
        if not req.get("landmarks"):
            raise ValueError("upload a landmarks .npy file")
        a = self.args
        with tempfile.TemporaryDirectory() as td:
            img_path = os.path.join(td, "image.png")
            cv2.imwrite(img_path, data_url_to_array(req["image"])[..., ::-1])
            lm_path = os.path.join(td, "landmarks.npy")
            with open(lm_path, "wb") as f:
                f.write(base64.b64decode(req["landmarks"]))
            out_path = os.path.join(td, "out.mp4")
            argv = ["--image", img_path, "--landmarks", lm_path, "--output", out_path,
                    "--target_size", str(int(req.get("target_size", a.target_size))),
                    "--num_inference_steps", str(a.num_inference_steps),
                    "--seed", str(a.seed), "--device", a.device]
            if a.tiny:
                argv.append("--tiny")
            if a.bf16:
                argv.append("--bf16")
            # the keypoint app takes neither tracks nor a face mask
            if mode == "hybrid" and req.get("tracks"):
                tr_path = os.path.join(td, "tracks.json")
                with open(tr_path, "w") as f:
                    json.dump({"tracks": req["tracks"]}, f)
                argv += ["--tracks", tr_path]
            if mode == "hybrid" and req.get("brush"):
                mask = data_url_to_array(req["brush"]).max(axis=-1)
                if mask.max() > 0:
                    mask_path = os.path.join(td, "mask.png")
                    cv2.imwrite(mask_path, mask)
                    argv += ["--face_mask", mask_path]
            if mode == "hybrid":
                from mofa_tpu_torch.apps import hybrid_app as app
            else:
                from mofa_tpu_torch.apps import keypoint_app as app
            with self._lock:
                app.run(app.build_parser().parse_args(argv))
                with open(out_path, "rb") as f:
                    self.last_video = f.read()
        return {"video": "/video"}


def _mp4_bytes(frames, fps: int) -> bytes:
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "out.mp4")
        write_video(frames, path, fps=fps)
        with open(path, "rb") as f:
            return f.read()


def make_handler(backend: TrajUIBackend):
    routes = {"/preprocess": backend.preprocess, "/preview": backend.preview,
              "/run": backend.run, "/run_landmarks": backend.run_landmarks}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif self.path.startswith("/video") and backend.last_video:
                self._send(200, backend.last_video, "video/mp4")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            route = routes.get(self.path)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if route is None:
                self._send(404, b"not found", "text/plain")
                return
            try:
                reply = json.dumps(route(json.loads(body))).encode()
            except Exception as e:  # the page's log pane shows the message
                logger.error(f"POST {self.path} failed:\n{traceback.format_exc()}")
                self._send(500, str(e).encode(), "text/plain")
                return
            self._send(200, reply)
    return Handler


def build_parser():
    p = argparse.ArgumentParser(description="MOFA-Video browser UI (PyTorch)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--svd_dir", default=None)
    p.add_argument("--controlnet_dir", default=None)
    p.add_argument("--cmp_ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=25)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--target_size", type=int, default=512)
    p.add_argument("--ctrl_scale", type=float, default=0.6)
    p.add_argument("--decode_chunk_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    return p


def make_server(args) -> ThreadingHTTPServer:
    """The HTTP server on (args.host, args.port) (port 0: any free one),
    not yet serving; its backend is `server.backend`."""
    backend = TrajUIBackend(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(backend))
    server.backend = backend
    return server


def main(argv=None):
    server = make_server(build_parser().parse_args(argv))
    host, port = server.server_address[:2]
    logger.info(f"MOFA-Video UI at http://{host}:{port} on {server.backend.device}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
