"""The embedded C++ runtime export (counterpart of
``omg_tools_tpu.export``): ``ExportP2P``, ``ExportFormation`` and
``ExportRendezVous`` write a problem's tensors and the runtime's sources
(``cpp/``) into a directory that builds with ``make``."""
