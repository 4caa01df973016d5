"""Interactive OpenGL map viewer (reference voldor_viewer.py:20-333 parity;
the port's copy of ``voldor_tpu/slam/gl_viewer.py``).

A live GLUT window rendering the keyframe point cloud, camera trajectory and
pose-graph edges while the SLAM threads run. The point-cloud data path is
shared with the headless viewer (``VOLDOR_Viewer.rebuild_points`` /
``save_ply``) — this module only adds the window, so headless deployments
(no DISPLAY / no PyOpenGL) are unaffected: ``GLViewer.available()`` gates
construction, and ``demo.py`` falls back to the headless watch loop.

Interaction (reference keyboard map, voldor_viewer.py:262-314):
  drag-left   orbit        drag-right  pan
  scroll      zoom         q  quit
  r  reset view            w/s  point size +/-
  a/d  sample stride +/-   h  cycle cams/edges visibility
  f  follow current cam    m  dump ./pc.ply
"""

from __future__ import annotations

import os
import time

import numpy as np

from voldor_tpu_torch.slam.viewer import VOLDOR_Viewer


class GLViewer:
    """Wraps a VOLDOR_Viewer data source with a GLUT render loop."""

    @staticmethod
    def available() -> bool:
        if not os.environ.get("DISPLAY") and os.name != "nt":
            return False
        try:
            import OpenGL.GLUT  # noqa: F401

            return True
        except Exception:
            return False

    def __init__(self, slam, width=1000, height=800, point_size=2, stride=2):
        self.slam = slam
        self.data = VOLDOR_Viewer(slam, stride=stride)
        self.width, self.height = width, height
        self.point_size = point_size
        self.view_box = 30.0
        self.center = np.zeros(3, np.float64)
        self.euler = np.array([0.0, 0.0, 0.0])  # orbit angles (rad)
        self.follow = False
        self.hide_cams = 0
        self._mouse = {"x": 0, "y": 0, "l": False, "r": False}
        self._dirty = True
        self._quit = False
        self._poll_loop = None  # set by start(); freeglut's glutMainLoopEvent
        # Called once before the viewer tears the process down on 'q'
        # (classic GLUT's main loop cannot return, so the hard-exit path
        # must run the caller's epilogue — demo.py's --save_* flags).
        self.on_exit = None

    # -- data ----------------------------------------------------------
    def _refresh(self):
        if self.slam._viewer_signal_map_changed or self._dirty:
            self.slam._viewer_signal_map_changed = False
            self._dirty = False
            self.data.rebuild_points()

    # -- GL ------------------------------------------------------------
    def _draw(self):
        from OpenGL.GL import (
            GL_COLOR_ARRAY, GL_COLOR_BUFFER_BIT, GL_DEPTH_BUFFER_BIT,
            GL_DEPTH_TEST, GL_FLOAT, GL_LINE_STRIP, GL_MODELVIEW,
            GL_POINTS, GL_PROJECTION, GL_UNSIGNED_BYTE, GL_VERTEX_ARRAY,
            glBegin, glClear, glClearColor, glColor3f, glColorPointer,
            glDisableClientState, glDrawArrays, glEnable,
            glEnableClientState, glEnd, glLineWidth, glLoadIdentity,
            glMatrixMode, glOrtho, glPointSize, glVertex3f, glVertexPointer,
        )
        from OpenGL.GLU import gluLookAt
        from OpenGL.GLUT import glutGet, glutSwapBuffers
        from OpenGL.GLUT import GLUT_WINDOW_HEIGHT, GLUT_WINDOW_WIDTH

        self._refresh()
        w = max(glutGet(GLUT_WINDOW_WIDTH), 1)
        h = max(glutGet(GLUT_WINDOW_HEIGHT), 1)
        glEnable(GL_DEPTH_TEST)
        glClearColor(0.92, 0.92, 0.92, 0)
        glClear(GL_COLOR_BUFFER_BIT | GL_DEPTH_BUFFER_BIT)

        glMatrixMode(GL_PROJECTION)
        glLoadIdentity()
        s = w / h
        glOrtho(-self.view_box * s, self.view_box * s,
                -self.view_box, self.view_box, -1000, 1000)

        glMatrixMode(GL_MODELVIEW)
        glLoadIdentity()
        cy, cx = np.cos(self.euler[:2]), np.sin(self.euler[:2])
        eye = np.array([
            10.0 * cx[0] * cy[1],
            10.0 * cx[1],
            -10.0 * cy[0] * cy[1],
        ])
        center = self.center.copy()
        if self.follow and self.slam.frames:
            center = self.slam.frames[-1].Tcw[:3, 3].astype(np.float64)
        gluLookAt(*(center + eye), *center, 0, -1, 0)

        pts, cols = self.data._points, self.data._colors
        if pts.shape[0]:
            glEnableClientState(GL_VERTEX_ARRAY)
            glEnableClientState(GL_COLOR_ARRAY)
            glVertexPointer(3, GL_FLOAT, 0, np.ascontiguousarray(pts))
            glColorPointer(3, GL_UNSIGNED_BYTE, 0, np.ascontiguousarray(cols))
            glPointSize(self.point_size)
            glDrawArrays(GL_POINTS, 0, pts.shape[0])
            glDisableClientState(GL_COLOR_ARRAY)
            glDisableClientState(GL_VERTEX_ARRAY)

        if self.hide_cams % 2 == 0:
            traj = self.data.trajectory()
            if traj.shape[0] >= 2:
                glLineWidth(2.0)
                glColor3f(0.85, 0.2, 0.1)
                glBegin(GL_LINE_STRIP)
                for p in traj:
                    glVertex3f(float(p[0]), float(p[1]), float(p[2]))
                glEnd()

        glutSwapBuffers()
        time.sleep(0.01)

    # -- input ---------------------------------------------------------
    def _on_key(self, bkey, x, y):
        key = bkey.decode("utf-8").lower()
        if key == "q":
            self._quit = True
            if self._poll_loop is None:
                # classic GLUT: glutMainLoop can never return, so run the
                # caller's epilogue (saves) here, then hard-exit
                if self.on_exit is not None:
                    try:
                        self.on_exit()
                    except Exception:
                        pass
                os._exit(0)
        elif key == "r":
            self.center[...] = 0
            self.euler[...] = 0
        elif key == "w":
            self.point_size += 1
        elif key == "s":
            self.point_size = max(self.point_size - 1, 1)
        elif key == "a":
            self.data.stride += 1
            self._dirty = True
        elif key == "d":
            self.data.stride = max(self.data.stride - 1, 1)
            self._dirty = True
        elif key == "h":
            self.hide_cams += 1
        elif key == "f":
            self.follow = not self.follow
        elif key == "m":
            self.data.save_ply("./pc.ply")

    def _on_click(self, button, state, x, y):
        self._mouse["x"], self._mouse["y"] = x, y
        if button == 0:
            self._mouse["l"] = state == 0
        elif button == 2:
            self._mouse["r"] = state == 0
        elif button == 3 and state == 0:
            self.view_box = max(self.view_box / 1.1, 1.0)
        elif button == 4 and state == 0:
            self.view_box *= 1.1

    def _on_motion(self, x, y):
        dx = x - self._mouse["x"]
        dy = y - self._mouse["y"]
        self._mouse["x"], self._mouse["y"] = x, y
        if self._mouse["l"]:
            self.euler[0] += dx * 0.01
            self.euler[1] = np.clip(self.euler[1] + dy * 0.01, -1.5, 1.5)
        elif self._mouse["r"]:
            self.center[0] -= dx * self.view_box / 300.0
            self.center[1] -= dy * self.view_box / 300.0

    # -- loop ----------------------------------------------------------
    def start(self, done=None):
        """Open the window and run the GLUT loop (run the SLAM threads
        first — the reference does the same, demo.py:77-90).

        With freeglut (`glutMainLoopEvent` available) the loop POLLS, so it
        returns to the caller on 'q' or once `done()` (e.g. "SLAM threads
        finished") goes true — letting demo.py run its --save_* epilogue.
        Classic GLUT has no returning loop; there the 'q' handler runs
        `self.on_exit` before the unavoidable `os._exit` (see _on_key)."""
        from OpenGL.GLUT import (
            GLUT_DEPTH, GLUT_DOUBLE, GLUT_RGBA, glutCreateWindow,
            glutDisplayFunc, glutIdleFunc, glutInit, glutInitDisplayMode,
            glutInitWindowSize, glutKeyboardFunc, glutMainLoop,
            glutMotionFunc, glutMouseFunc, glutPostRedisplay,
        )

        try:
            from OpenGL.GLUT import glutMainLoopEvent  # freeglut extension
        except ImportError:
            glutMainLoopEvent = None
        self._poll_loop = glutMainLoopEvent

        glutInit()
        glutInitDisplayMode(GLUT_RGBA | GLUT_DOUBLE | GLUT_DEPTH)
        glutInitWindowSize(self.width, self.height)
        glutCreateWindow(b"voldor_tpu_torch")
        glutDisplayFunc(self._draw)
        glutIdleFunc(glutPostRedisplay)
        glutKeyboardFunc(self._on_key)
        glutMouseFunc(self._on_click)
        glutMotionFunc(self._on_motion)
        if glutMainLoopEvent is None:
            glutMainLoop()
        else:
            while not self._quit and not (done is not None and done()):
                glutMainLoopEvent()
