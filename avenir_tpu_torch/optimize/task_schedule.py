"""TaskSchedule example domain (port of
``avenir_tpu/optimize/task_schedule.py``): project assignment with travel
costs.

Parity target: examples/TaskScheduleSearch.java (+ TaskSchedule/Task/
Employee/Location beans) configured by resource/taskSched.json — the
reference domain for the SA/GA optimizers (SURVEY.md §2.7).

Cost of assigning employee e to task t (TaskScheduleSearch.calculateCost
:182-237) = average of four costScale-normalized parts:
  * travel: haversine miles between task and employee home locations;
    < airTravelDistThreshold -> 2*dist*perMileDriveCost, else the quadratic
    air-fare estimator; normalized by maxTravelCost;
  * per-diem: task location per-diem rate / maxPerDiemRate;
  * hotel: task location hotel rate / maxHotelRate;
  * skill match: unmatched required skills fraction.
Validity (isValid :267-287): tasks assigned to the same employee must be
at least minDaysGap days apart; invalid solutions cost
inavlidSolutionCost (reference's key spelling preserved).

The whole cost function collapses to a precomputed (tasks, employees)
matrix + a task-pair conflict matrix, so a batch of solutions evaluates
as one gather + reduction on the device (MatrixCostDomain).
"""

from __future__ import annotations

import json
import math
import re
from datetime import datetime
from typing import Dict

import numpy as np

from .domain import MatrixCostDomain

EARTH_RADIUS_MILES = 3958.75


def geo_distance(lat1, lon1, lat2, lon2) -> float:
    """Haversine distance in miles (chombo BasicUtils.getGeoDistance)."""
    la1, lo1, la2, lo2 = map(math.radians, (lat1, lon1, lat2, lon2))
    a = math.sin((la2 - la1) / 2) ** 2 + \
        math.cos(la1) * math.cos(la2) * math.sin((lo2 - lo1) / 2) ** 2
    return 2 * EARTH_RADIUS_MILES * math.asin(min(1.0, math.sqrt(a)))


def _lenient_json(text: str):
    """Jackson-lenient parse: the reference's taskSched.json has trailing
    commas that strict json rejects."""
    cleaned = re.sub(r",\s*([}\]])", r"\1", text)
    return json.loads(cleaned)


class TaskScheduleDomain(MatrixCostDomain):
    """positions = tasks, choices = employees."""

    def __init__(self, config: Dict):
        self.config = config
        locations = {l["id"]: l for l in config["locations"]}
        tasks = config["tasks"]
        employees = config["employees"]
        self.task_ids = [t["id"] for t in tasks]
        self.employee_ids = [e["id"] for e in employees]
        from ..utils.timefmt import java_time_format
        py_fmt = java_time_format(config.get("dateFormat", "MM-dd-yyyy"))
        scale = float(config.get("costScale", 100))
        air_thr = float(config.get("airTravelDistThreshold", 100))
        per_mile = float(config.get("perMileDriveCost", 0.56))
        air_est = config.get("airFareEstimator", [0.0, 0.0, 0.0])
        max_travel = float(config.get("maxTravelCost", 1))
        max_per_diem = float(config.get("maxPerDiemRate", 1))
        max_hotel = float(config.get("maxHotelRate", 1))

        T, E = len(tasks), len(employees)
        cost = np.zeros((T, E))
        starts = np.zeros((T,), dtype=np.int64)
        ends = np.zeros((T,), dtype=np.int64)
        for ti, task in enumerate(tasks):
            t_loc = locations[task["location"]]
            t_gps = t_loc["gps"]
            start = datetime.strptime(task["startDate"], py_fmt)
            end = datetime.strptime(task["endDate"], py_fmt)
            starts[ti] = int(start.timestamp() * 1000)
            ends[ti] = int(end.timestamp() * 1000)
            # duration in days (reference adds 4 ms slop then divides)
            duration = max((ends[ti] - starts[ti] + 4) // 86_400_000, 1)
            per_diem = duration * t_loc.get("perDiemCost", 0)
            per_diem = per_diem / (duration * max_per_diem) * scale
            hotel = duration * t_loc.get("hotelCost", 0)
            hotel = hotel / (duration * max_hotel) * scale
            t_skills = set(task.get("skills", []))
            for ei, emp in enumerate(employees):
                e_loc = locations[emp["location"]]
                e_gps = e_loc["gps"]
                dist = geo_distance(t_gps[0], t_gps[1], e_gps[0], e_gps[1])
                if dist < air_thr:
                    travel = 2 * dist * per_mile
                else:
                    travel = air_est[0] * dist * dist + air_est[1] * dist + \
                        air_est[2]
                travel = travel / max_travel * scale
                matched = len(t_skills & set(emp.get("skills", [])))
                skill = (len(t_skills) - matched) * scale / max(len(t_skills), 1)
                cost[ti, ei] = (travel + per_diem + hotel + skill) / 4.0

        # conflict matrix: pairs of tasks too close together in time cannot
        # share an employee (isValid's minDaysGap check)
        min_gap_ms = config.get("minDaysGap", 0) * 86_400_000 - 4
        conflict = np.zeros((T, T))
        for i in range(T):
            for j in range(i + 1, T):
                gap = max(starts[j] - ends[i], starts[i] - ends[j])
                if gap < min_gap_ms:
                    conflict[i, j] = conflict[j, i] = 1.0
        # missing key must not make invalid solutions the optimum; a large
        # FINITE penalty keeps Metropolis deltas and counter sums arithmetic-
        # safe (inf would propagate into cost accumulators and overflow int())
        invalid_cost = float(config.get("inavlidSolutionCost", 1e9))

        super().__init__(cost_matrix=cost, conflict=conflict,
                         conflict_penalty=invalid_cost, average=True)

    @classmethod
    def load(cls, path: str) -> "TaskScheduleDomain":
        with open(path) as fh:
            return cls(_lenient_json(fh.read()))

    # reference component format: 'taskId:employeeId'
    def component_str(self, position: int, choice: int) -> str:
        return f"{self.task_ids[position]}:{self.employee_ids[choice]}"

    def parse_component(self, comp: str):
        t, e = comp.split(":")
        return self.task_ids.index(t), self.employee_ids.index(e)
