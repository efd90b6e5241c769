"""Self-contained HTML scene viewer ("watch the map grow" surface).

The reference opens a live Open3D window on the training machine
(train.py:41-47,362-368). A TPU-pod host is headless, so the equivalent
here is an artifact: every mesh export also writes ``viewer.html`` + a
``meshes_frame_<f>.js`` snapshot into the mesh directory. Opening the HTML
in any browser (file:// included — mesh data loads via <script>, which
needs no CORS) gives an orbitable, per-object-toggleable WebGL view of the
reconstruction at each exported frame; the frame selector flips between
snapshots, so the map's growth over training is scrubbable.

No external JS dependencies — the renderer is a ~100-line WebGL1 program
embedded in the page.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _mesh_payload(obj_id: int, mesh) -> dict:
    v = np.asarray(mesh.vertices, np.float32)
    f = np.asarray(mesh.faces, np.int32)
    if mesh.vertex_colors is not None:
        c = np.asarray(mesh.vertex_colors, np.uint8)
    else:
        c = np.full((len(v), 3), 180, np.uint8)
    return {
        "id": int(obj_id),
        "v": [round(float(x), 4) for x in v.reshape(-1)],
        "f": f.reshape(-1).tolist(),
        "c": c.reshape(-1).tolist(),
    }


def write_snapshot(mesh_dir: str, meshes: dict, frame_id: int) -> str:
    """Write ``meshes_frame_<f>.js`` (+ index + viewer page) for the given
    {obj_id: Mesh | None} dict. Returns the viewer path."""
    os.makedirs(mesh_dir, exist_ok=True)
    payload = [_mesh_payload(oid, m) for oid, m in sorted(meshes.items())
               if m is not None and len(m.faces)]
    js = os.path.join(mesh_dir, f"meshes_frame_{frame_id}.js")
    with open(js, "w") as f:
        f.write("VMAP_REGISTER(%d, %s);" % (frame_id, json.dumps(payload)))
    # frame index (a js file so file:// works)
    idx_path = os.path.join(mesh_dir, "frames_index.js")
    frames = []
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            txt = f.read()
        start, end = txt.find("["), txt.rfind("]")
        if start >= 0:
            frames = json.loads(txt[start:end + 1])
    if frame_id not in frames:
        frames.append(frame_id)
        frames.sort()
    with open(idx_path, "w") as f:
        f.write("var VMAP_FRAMES = %s;" % json.dumps(frames))
    viewer = os.path.join(mesh_dir, "viewer.html")
    if not os.path.exists(viewer):
        with open(viewer, "w") as f:
            f.write(_VIEWER_HTML)
    return viewer


_VIEWER_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vmap_tpu scene viewer</title>
<style>
 body{margin:0;background:#16181d;color:#dde;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px 10px;border-radius:6px;max-height:92vh;overflow:auto}
 #hud label{display:block;cursor:pointer}
 canvas{display:block}
 select{margin-bottom:6px}
</style></head><body>
<canvas id="gl"></canvas>
<div id="hud">
 <div><b>vmap_tpu</b> scene viewer</div>
 <div>frame <select id="frameSel"></select></div>
 <div id="objs"></div>
 <div style="opacity:.6">drag: orbit &middot; wheel: zoom</div>
</div>
<script>var VMAP_DATA={};function VMAP_REGISTER(f,m){VMAP_DATA[f]=m;}</script>
<script src="frames_index.js"></script>
<script>
for (const f of VMAP_FRAMES){ document.write('<script src="meshes_frame_'+f+'.js"><\/script>'); }
</script>
<script>
const canvas=document.getElementById('gl');
const gl=canvas.getContext('webgl');
const VS=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;uniform mat4 mv;
varying vec3 vc;varying vec3 vp;
void main(){gl_Position=mvp*vec4(p,1.0);vp=(mv*vec4(p,1.0)).xyz;vc=c;}`;
const FS=`precision mediump float;varying vec3 vc;varying vec3 vp;
void main(){vec3 n=normalize(cross(dFdx(vp),dFdy(vp)));
float l=0.35+0.65*abs(n.z);gl_FragColor=vec4(vc*l,1.0);}`;
gl.getExtension('OES_standard_derivatives');
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s.replace('precision mediump float;','#extension GL_OES_standard_derivatives : enable\nprecision mediump float;'));gl.compileShader(o);
 if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,'p'),locC=gl.getAttribLocation(prog,'c');
const locMVP=gl.getUniformLocation(prog,'mvp'),locMV=gl.getUniformLocation(prog,'mv');
let bufs=[],center=[0,0,0],radius=3,theta=0.6,phi=-0.5,dist=3;
function load(frame){
 bufs.forEach(b=>{gl.deleteBuffer(b.vb);gl.deleteBuffer(b.cb);gl.deleteBuffer(b.ib);});
 bufs=[];const hud=document.getElementById('objs');hud.innerHTML='';
 let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
 for(const m of (VMAP_DATA[frame]||[])){
  const v=new Float32Array(m.v),c=new Uint8Array(m.c);
  for(let i=0;i<v.length;i+=3)for(let k=0;k<3;k++){lo[k]=Math.min(lo[k],v[i+k]);hi[k]=Math.max(hi[k],v[i+k]);}
  const vb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,vb);gl.bufferData(gl.ARRAY_BUFFER,v,gl.STATIC_DRAW);
  const cb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,cb);gl.bufferData(gl.ARRAY_BUFFER,c,gl.STATIC_DRAW);
  const ib=gl.createBuffer();gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,new Uint32Array(m.f),gl.STATIC_DRAW);
  const b={vb,cb,ib,n:m.f.length,on:true,id:m.id};bufs.push(b);
  const lab=document.createElement('label');
  const cb2=document.createElement('input');cb2.type='checkbox';cb2.checked=true;
  cb2.onchange=()=>{b.on=cb2.checked;};
  lab.appendChild(cb2);lab.appendChild(document.createTextNode(' obj '+m.id));
  hud.appendChild(lab);
 }
 if(bufs.length){center=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
  radius=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])*0.75+1e-3;dist=radius*2.2;}
}
gl.getExtension('OES_element_index_uint');
function mat(){ // row-major helpers flattened column-major at upload
 const ct=Math.cos(theta),st=Math.sin(theta),cp=Math.cos(phi),sp=Math.sin(phi);
 const eye=[center[0]+dist*ct*Math.cos(phi),center[1]+dist*sp,center[2]+dist*st*Math.cos(phi)];
 const f=norm([center[0]-eye[0],center[1]-eye[1],center[2]-eye[2]]);
 const r=norm(cross(f,[0,1,0])),u=cross(r,f);
 const mv=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
  -(r[0]*eye[0]+r[1]*eye[1]+r[2]*eye[2]),-(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
  (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]),1];
 const a=canvas.width/canvas.height,fv=1.2,n=0.01*radius,fa=100*radius;
 const t=1/Math.tan(fv/2);
 const pr=[t/a,0,0,0, 0,t,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 return [mul(pr,mv),mv];
}
function norm(v){const l=Math.hypot(v[0],v[1],v[2]);return [v[0]/l,v[1]/l,v[2]/l];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function mul(a,b){const o=new Array(16).fill(0);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)o[j*4+i]+=a[k*4+i]*b[j*4+k];return o;}
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.086,0.094,0.113,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const [mvp,mv]=mat();
 gl.uniformMatrix4fv(locMVP,false,new Float32Array(mvp));
 gl.uniformMatrix4fv(locMV,false,new Float32Array(mv));
 for(const b of bufs){if(!b.on)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,b.vb);gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,b.cb);gl.enableVertexAttribArray(locC);
  gl.vertexAttribPointer(locC,3,gl.UNSIGNED_BYTE,true,0,0);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,b.ib);
  gl.drawElements(gl.TRIANGLES,b.n,gl.UNSIGNED_INT,0);}
 requestAnimationFrame(draw);
}
let drag=false,lx=0,ly=0;
canvas.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;theta+=(e.clientX-lx)*0.01;
 phi=Math.max(-1.5,Math.min(1.5,phi+(e.clientY-ly)*0.01));lx=e.clientX;ly=e.clientY;};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
const sel=document.getElementById('frameSel');
for(const f of VMAP_FRAMES){const o=document.createElement('option');o.value=f;o.text=f;sel.appendChild(o);}
sel.value=VMAP_FRAMES[VMAP_FRAMES.length-1];
sel.onchange=()=>load(+sel.value);
load(+sel.value);draw();
</script></body></html>
"""
