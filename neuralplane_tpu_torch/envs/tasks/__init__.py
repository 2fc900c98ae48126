from .control import ControlTask, ControlTaskState
from .heading import HeadingTask, HeadingTaskState
from .tracking import TrackingTask, TrackingTaskState

TASKS = {
    "heading": HeadingTask,
    "control": ControlTask,
    "tracking": TrackingTask,
}
