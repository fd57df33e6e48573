"""Live in-browser viewer: watch a run (offline replay or ``--stream``) as it
happens.

ROS-free stand-in for the reference's rviz channel (PubSurfels MarkerArray
ellipsoids + TF world->imu_link every sweep, surfel_extraction.cc:360-434,
lidar_odometry.cc:582-602). A tiny stdlib HTTP server exposes:

  /        self-contained HTML/JS orbit viewer (no external assets — works
           with zero egress); canvas 2D painter's-algorithm projection of the
           trajectory polyline + surfel ellipse sprites colored by normal
  /state   JSON snapshot: trajectory, current pose, surfel centers/axes/rgb

The CLI wires it via ``--viewer-port N``; ``LiveViewer.update(...)`` is called
once per sweep from the host loop (numpy only, never blocks device work — the
state swap is a single reference assignment under a lock).

A copy of ``wildcat_slam_tpu/viz/live.py`` (stdlib and numpy only; a test
holds its code equal to the original's), so that the port imports nothing of
the JAX package. The port's CLI hands it ``surfel_ellipsoids`` of the
window's surfels copied to the host.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>wildcat-slam-tpu live</title>
<style>
 body{margin:0;background:#101014;color:#cfcfd6;font:12px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;line-height:1.5;pointer-events:none;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),cx=cv.getContext('2d'),hud=document.getElementById('hud');
let st=null, yaw=-0.7, pitch=0.45, dist=18, cen=[0,0,0], drag=null, follow=true;
function resize(){cv.width=innerWidth;cv.height=innerHeight;} resize(); onresize=resize;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){const s=dist/500;cen[0]-=s*(dx*Math.cos(yaw)-dy*Math.sin(yaw));
  cen[1]+=s*(dx*Math.sin(yaw)+dy*Math.cos(yaw));follow=false;}
 else{yaw-=dx*0.008;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);};
ondblclick=()=>follow=true;
function proj(p){
 const x=p[0]-cen[0],y=p[1]-cen[1],z=p[2]-cen[2];
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const x1=cy*x+sy*y, y1=-sy*x+cy*y;
 const y2=cp*y1-sp*z, z2=sp*y1+cp*z;
 const d=dist+x1;
 if(d<0.2)return null;
 const f=0.9*Math.min(cv.width,cv.height)/d;
 return [cv.width/2+f*y2, cv.height/2-f*z2, f, x1];
}
function draw(){
 cx.fillStyle='#101014';cx.fillRect(0,0,cv.width,cv.height);
 if(!st){requestAnimationFrame(draw);return;}
 if(follow&&st.pose)cen=st.pose.slice(0,3);
 // ground grid
 cx.strokeStyle='#23232c';cx.lineWidth=1;
 const g=Math.round(cen[0]),h=Math.round(cen[1]);
 for(let i=-10;i<=10;i++){
  let a=proj([g+i,h-10,0]),b=proj([g+i,h+10,0]);
  if(a&&b){cx.beginPath();cx.moveTo(a[0],a[1]);cx.lineTo(b[0],b[1]);cx.stroke();}
  a=proj([g-10,h+i,0]);b=proj([g+10,h+i,0]);
  if(a&&b){cx.beginPath();cx.moveTo(a[0],a[1]);cx.lineTo(b[0],b[1]);cx.stroke();}}
 // surfels: depth-sorted ellipse sprites
 if(st.surfels){
  const S=st.surfels, idx=[];
  for(let i=0;i<S.c.length;i++){const p=proj(S.c[i]);if(p)idx.push([p[3],i,p]);}
  idx.sort((a,b)=>b[0]-a[0]);
  for(const [,i,p] of idx){
   const r=S.rgb[i];
   cx.fillStyle=`rgba(${r[0]*255|0},${r[1]*255|0},${r[2]*255|0},0.55)`;
   const a1=S.a1[i],a2=S.a2[i];           // two largest 3-sigma semi-axes (world)
   const q1=proj([S.c[i][0]+a1[0],S.c[i][1]+a1[1],S.c[i][2]+a1[2]]);
   const q2=proj([S.c[i][0]+a2[0],S.c[i][1]+a2[1],S.c[i][2]+a2[2]]);
   if(!q1||!q2)continue;
   const u=[q1[0]-p[0],q1[1]-p[1]], v=[q2[0]-p[0],q2[1]-p[1]];
   cx.save();cx.transform(u[0],u[1],v[0],v[1],p[0],p[1]);
   cx.beginPath();cx.arc(0,0,1,0,6.2832);cx.fill();cx.restore();}
 }
 // trajectory
 if(st.traj&&st.traj.length>1){
  cx.strokeStyle='#6ab0ff';cx.lineWidth=2;cx.beginPath();let started=false;
  for(const p of st.traj){const q=proj(p);if(!q){started=false;continue;}
   if(started)cx.lineTo(q[0],q[1]);else{cx.moveTo(q[0],q[1]);started=true;}}
  cx.stroke();}
 if(st.pose){const q=proj(st.pose);if(q){cx.fillStyle='#ffd166';
  cx.beginPath();cx.arc(q[0],q[1],5,0,6.2832);cx.fill();}}
 hud.textContent=`sweep ${st.sweep}  t=${st.t.toFixed(2)}s  surfels ${st.surfels?st.surfels.c.length:0}`
  +`\\ndrag orbit | shift-drag pan | wheel zoom | dbl-click follow`;
 requestAnimationFrame(draw);
}
async function poll(){
 try{const r=await fetch('/state');if(r.ok)st=await r.json();}catch(e){}
 setTimeout(poll,250);
}
poll();draw();
</script></body></html>"""


class LiveViewer:
    """Background HTTP server holding the latest run snapshot."""

    def __init__(self, port: int = 8433, max_surfels: int = 2000, max_traj: int = 4000):
        self._lock = threading.Lock()
        self._state_json = json.dumps({"sweep": 0, "t": 0.0, "traj": [], "pose": None})
        self._traj: list = []
        self._max_surfels = max_surfels
        self._max_traj = max_traj
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.split("?")[0] == "/state":
                    body = viewer._state_json.encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request spam
                pass

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def update(self, sweep: int, t: float, pos, surfels: dict | None = None) -> None:
        """Publish one sweep: current pose position and (optionally) the surfel
        ellipsoid dict from viz.surfel_export.surfel_ellipsoids."""
        pos = [round(float(v), 4) for v in np.asarray(pos).reshape(3)]
        self._traj.append(pos)
        if len(self._traj) > self._max_traj:
            self._traj = self._traj[:: 2]
        state = {"sweep": int(sweep), "t": float(t), "pose": pos, "traj": self._traj}
        if surfels is not None and len(surfels["center"]):
            c = np.asarray(surfels["center"], np.float32)
            if len(c) > self._max_surfels:
                sel = np.linspace(0, len(c) - 1, self._max_surfels).astype(int)
            else:
                sel = np.arange(len(c))
            ax = np.asarray(surfels["axes"], np.float32)[sel]      # (N,3,3) columns=axes
            ra = np.asarray(surfels["radii"], np.float32)[sel]     # (N,3) ascending
            rgb = np.asarray(surfels["rgb"], np.float32)[sel]
            # two largest 3-sigma semi-axis vectors span the ellipse sprite
            a1 = ax[:, :, 2] * ra[:, 2:3]
            a2 = ax[:, :, 1] * ra[:, 1:2]
            rnd = lambda a: np.round(a, 4).tolist()  # noqa: E731
            state["surfels"] = {"c": rnd(c[sel]), "a1": rnd(a1), "a2": rnd(a2),
                                "rgb": np.round(rgb, 3).tolist()}
        with self._lock:
            self._state_json = json.dumps(state)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
