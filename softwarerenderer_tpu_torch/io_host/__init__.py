"""Host-side services: asset import, present/window, audio, networking, UI.

The reference consumes these roles through native NuGet bindings (Assimp,
SDL2, GLFW/OpenGL, cimgui — SURVEY.md §2); here they are first-party host
Python around the device-resident render/sim core.
"""
